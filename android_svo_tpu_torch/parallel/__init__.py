"""Multi-sequence and multi-device execution: the batched tracking step
(`multi_seq.py`), the (data, map) mesh on `torch.distributed` (`mesh.py`)
and local bundle adjustment, on one device or sharded (`ba.py`)."""
