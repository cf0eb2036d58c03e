"""The H100 benchmark of nlos_surface_optimization_torch (see README.md)."""
