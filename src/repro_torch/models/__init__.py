"""Model zoo of the port: the GNN models (the transformer side workload
arrives with its own slice)."""
