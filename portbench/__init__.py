"""The port's benchmark: closed-loop model serving through
``repro_torch``'s Runtime on one H100 (``python3 portbench/run.py``)."""
