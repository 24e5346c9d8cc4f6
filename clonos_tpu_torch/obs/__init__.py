"""Observability planes of the port: the exactly-once audit (per-epoch
digests sealed into a ledger, re-validated after recovery)."""
