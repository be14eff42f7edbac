"""Reliability pieces the influence engine reads: the query solver
ladder and the non-finite payload check."""
