"""The plain reference of the benchmark: PyTorch and NumPy only, importing
nothing of the program.  `stabilizer.Chain` works a chain's outputs out
from the true camera path; `compare` measures a program's output against
them."""
