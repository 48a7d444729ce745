"""NVIDIA H100 SXM5 constants (the port's target; the reference's are a
TPU v5e's).

Data-sheet rates: bf16 dense tensor-core peak and HBM3 bandwidth, the
values ``chip_smoke.py`` and PERF.md bound kernels with.  NVLink 4 gives a
GPU 900 GB/s in all, 450 GB/s in each direction, to the others of its
8-GPU node; across nodes a GPU has one 400 Gb/s NIC, 50 GB/s.  The ring
model (``analyze.CollectiveStats``) charges a collective over a group of at
most :data:`NODE_GPUS` at NVLink rates and a larger one at the network's:
a 16-wide ``model`` axis spans two nodes.
"""

PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a GPU, each direction, inside a node
NETWORK_BW = 50e9  # bytes/s a GPU across nodes (one 400 Gb/s NIC)
NODE_GPUS = 8  # GPUs joined all to all by NVLink in one node

#: ``torch.cuda.get_device_properties(0).total_memory`` on an NVIDIA H100
#: 80GB HBM3 (``chip_smoke.py`` phase 13 prints it beside the card's name)
CHIP_HBM_BYTES = 85_017_493_504


def link_bw(group: int) -> float:
    """Bytes/s a GPU moves in a collective over ``group`` GPUs."""
    return NVLINK_BW if group <= NODE_GPUS else NETWORK_BW
