"""Numeric core ops (quaternions, vectors) on tensors, batch-first."""
