"""The benchmark of debvader_tpu_torch, the PyTorch and CUDA port.

``python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once (harness.py).  Nothing
here imports JAX or the JAX package; the reference (reference/) imports
nothing of the program.
"""
