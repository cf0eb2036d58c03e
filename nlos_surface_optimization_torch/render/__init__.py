"""Forward transient, analytic backward and the kernels' wrappers."""
