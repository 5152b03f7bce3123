"""Graph neural networks of the port (counterpart of ``repro.models.gnn``):
the graph container and message-passing primitives (``graph``), GAT
inference (``gat``), the irrep algebra (``e3``) and the equivariant GNNs
(``egnn``, ``nequip``, ``mace``)."""
