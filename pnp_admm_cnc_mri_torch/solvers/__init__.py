"""ADMM solvers of the classical slice."""
