"""The GNN family (torch port of ``repro/models/gnn``)."""
