"""Analysis of the port's dry-run records (``launch/dryrun.py``)."""
