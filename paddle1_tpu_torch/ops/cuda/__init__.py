"""CUDA C++ kernel sources (``*.cu``) and their builder."""
