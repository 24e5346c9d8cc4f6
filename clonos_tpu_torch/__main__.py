"""``python -m clonos_tpu_torch``: the command line (``cli.py``)."""

from clonos_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
