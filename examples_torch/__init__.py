"""The PyTorch/CUDA port's examples, counterparts of ``examples/`` by
file name.  Each has ``run(args, ...) -> dict``, which returns the
numbers it prints (tests and ``chip_smoke.py`` call it in-process), and
``main(argv=None)``.  Those that touch a device run on the CUDA card
unless ``--device cpu`` names the CPU:

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
