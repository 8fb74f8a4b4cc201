"""The reference's four example scripts (``examples/``) on the port, each
run as a module with the device it should use (default ``cuda``, which
fails without a GPU; ``--device cpu`` runs the plain PyTorch path):

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.elastic_training [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.secure_analytics [--device cpu]

Each prints what the reference's prints and takes an argument that
shortens it (steps, new tokens or shards) for the tests and
``chip_smoke.py``; its ``main`` returns what it printed, as values.
"""
