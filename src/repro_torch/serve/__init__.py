"""repro_torch.serve — online inference: the batching loop and the GNN
server. The LLM server on the same loop is ``repro_torch.launch.serve``;
the precomputed-embedding tier arrives with checkpoints."""
from repro_torch.serve.loop import (BatchingLoop, RequestQueue,
                                    ServeShutdown, Ticket)
from repro_torch.serve.server import GNNServer

__all__ = ["BatchingLoop", "RequestQueue", "ServeShutdown", "Ticket",
           "GNNServer"]
