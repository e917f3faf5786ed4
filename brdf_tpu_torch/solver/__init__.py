"""Solvers: grid init, robust weights, the unfused VarPro tier, LM result types."""
