"""repro_torch.serve — online GNN inference: the batching loop and the
GNN server. The precomputed-embedding tier and the LLM server arrive with
later slices."""
from repro_torch.serve.loop import (BatchingLoop, RequestQueue,
                                    ServeShutdown, Ticket)
from repro_torch.serve.server import GNNServer

__all__ = ["BatchingLoop", "RequestQueue", "ServeShutdown", "Ticket",
           "GNNServer"]
