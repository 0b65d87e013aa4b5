"""The paper's experiments on the port: one module per table or figure
(the twins of the reference's ``benchmarks/fig*.py``), their shared
``common`` and the suite runner ``run``.

    PYTHONPATH=src python -m repro_torch.experiments.run [--device cpu]

Each run is ``FedSAEServer`` on the host driver with the reference's
defaults; the JSON goes to ``experiments/paper_torch/``.
"""
