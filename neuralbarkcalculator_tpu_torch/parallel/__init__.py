"""Multi-process runs of the port: the process group and its collectives
(distributed.py), and cross-rank BatchNorm (sync_bn.py)."""
