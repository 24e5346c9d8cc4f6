"""Example jobs of the port (its own copies of the reference's
``examples/``)."""
