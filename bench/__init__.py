"""The benchmark of ``repro_torch`` on NVIDIA GPUs (see ``bench/run.py``)."""
