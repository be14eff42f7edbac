"""Influence engine, its gradient and solver primitives, and the
hand-written score kernels."""
