"""The port's benchmark: seconds per converged w* solve of the discrete
long-run-risk models at seeded parameter draws (``python3 -m wcbench.run``;
README.md beside this file)."""
