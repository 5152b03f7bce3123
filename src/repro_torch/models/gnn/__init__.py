"""Graph neural networks of the port (counterpart of ``repro.models.gnn``):
the graph container and message-passing primitives (``graph``) and GAT
inference (``gat``)."""
