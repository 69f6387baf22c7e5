"""Tensor-parallel layer functions, ported at tp=1."""
