"""Multi-device routes of the port over ``torch.distributed``.

Port of ``reveal_tpu/parallel/``: ``distributed`` (process groups and a
local world of processes), ``mesh`` (the mesh of ranks and the sharded
pipeline step) and ``dsa`` (the distributed suffix-array build).  JAX's
mesh of devices in one process becomes one process per rank in a process
group: gloo on the CPU, NCCL on cards.
"""
