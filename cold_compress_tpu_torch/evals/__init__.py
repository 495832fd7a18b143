"""The evaluation tasks and metrics, copies of the JAX package's
``evals/`` (which imports no JAX) kept in the port."""
