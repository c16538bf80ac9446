"""The mesh of torch.distributed ranks, its reductions, the spatially split
ADMM solve and the consensus solvers (one process, or sharded over the mesh)."""
