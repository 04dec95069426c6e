"""The examples of the README, on the port: each runs as ``python -m
dmlc_core_tpu_torch.examples.<name>`` on the card (``--device cpu`` runs it
on the host, ``--smoke`` at fewer rows, trees and epochs), and ``python -m
dmlc_core_tpu_torch.examples`` runs them all."""
