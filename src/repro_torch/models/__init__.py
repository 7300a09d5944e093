"""Model zoo of the port: the GNN models and the transformer side workload
(RWKV6 so far)."""
