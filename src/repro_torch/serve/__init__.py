"""repro_torch.serve — online inference: the batching loop, the tiered
GNN server (hot feature tier, precomputed-embedding tier, fresh compute)
and the offline full-graph precompute that feeds its cold tier. The LLM
server on the same loop is ``repro_torch.launch.serve``."""
from repro_torch.serve.loop import (BatchingLoop, RequestQueue,
                                    ServeShutdown, Ticket)
from repro_torch.serve.embeddings import (EmbeddingTable, embeddings_dir,
                                          load_embeddings,
                                          precompute_embeddings)
from repro_torch.serve.server import GNNServer

__all__ = ["BatchingLoop", "RequestQueue", "ServeShutdown", "Ticket",
           "EmbeddingTable", "embeddings_dir", "load_embeddings",
           "precompute_embeddings", "GNNServer"]
