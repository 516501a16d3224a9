"""The plain reference that judges a solve's answer: NumPy and SciPy only,
nothing of the program under test."""
