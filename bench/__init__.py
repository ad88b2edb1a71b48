"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
scheduler's placement sweeps and its daemon, measured on the card and
checked against the plain NumPy reference in ``bench/reference``.
Run a cell with ``python bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` lists the cells."""
