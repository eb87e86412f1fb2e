"""Traffic: one general generator (``omics.py``) and one data file of
parameters a mix (``<traffic>.json``)."""
