"""The reference package's four examples on the port: run each as
``python -m repro_torch.examples.<name> [--device cpu]`` (quickstart,
fleet_allocation, serve_llm, train_lm)."""
