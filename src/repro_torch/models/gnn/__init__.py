"""GNN model zoo (paper §7.1): GCN, GraphSAGE, GAT, DeepGCN, GNN-FiLM.

All models operate on fixed-fanout *tree blocks* (see
:mod:`repro_torch.graph.sampler`): per-hop feature tensors of shape
(B * f**h, d). Aggregation is a dense reshape+reduce, never a scatter.
"""
from repro_torch.models.gnn.models import (GNN, MODEL_REGISTRY, GNNConfig,
                                           gnn_accuracy, gnn_forward,
                                           gnn_loss, init_gnn,
                                           model_param_bytes,
                                           opt_state_from_jax,
                                           params_from_jax, params_to_tree)

__all__ = ["GNN", "GNNConfig", "MODEL_REGISTRY", "init_gnn", "gnn_forward",
           "gnn_loss", "gnn_accuracy", "model_param_bytes", "params_from_jax",
           "params_to_tree", "opt_state_from_jax"]
