"""The H100 benchmark of ``opticalflow_tpu_torch``: ``python portbench/run.py``."""
