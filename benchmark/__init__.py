"""The benchmark of the PyTorch and CUDA port, `nv_wavenet_tpu_torch`, on
NVIDIA H100 cards: `python3 benchmark/run.py --workload <cell> ...`."""
