"""Multi-GPU training over `torch.distributed`: the process group and the
data-parallel step (`mesh`), segment-table sharding (`fsdp`), the
collectives (`collectives`), rank 0's loader broadcast to every rank
(`feed`), the spawning launcher (`launch`) and the step on saved inputs
that the parity tests and `chip_smoke.py` launch (`harness`)."""
