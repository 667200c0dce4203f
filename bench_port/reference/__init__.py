"""Plain references of the benchmark's configurations: plain PyTorch and
NumPy/SciPy, importing nothing of the program under test.  The grid's
derives the discretization again from the benchmark's own inputs (with the
frozen host code in ``frozen/``); the tet domain's takes the program's tet
mesh as data, checks it against the stated domain and builds its
operators itself.  Each solves in float64 on the card and compares a solve
of the program with it (``numbers``).  ``control`` runs the same code one
precision lower (bfloat16, or float32 with TF32 products), the step a
later change would be tempted to take; it has to fail the comparison."""
