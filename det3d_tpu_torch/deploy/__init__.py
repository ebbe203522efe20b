"""Deployment: the exported detector artifact, its runtime, the RPN
microbenchmark and the reference-checkpoint crossings."""
