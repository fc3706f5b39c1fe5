"""Numeric phase of the port: supernodal factor and solve on torch tensors."""
