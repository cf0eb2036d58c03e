"""The benchmark's plain reference: the confocal renderer, its vertex
gradient, the culling intensity, the normal-smoothness regularizer and
Adam_Modified, in plain PyTorch at a chosen precision (float64 for the
check, bfloat16 for its control).

It imports torch and numpy only: nothing of the program under test and
nothing of JAX.  It works out again from the benchmark's own inputs what
the program derives (the threefry draws, face order, normals, weights),
and reads the program's outputs only to judge them.
"""
