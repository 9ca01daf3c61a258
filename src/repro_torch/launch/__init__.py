"""Launchers and the steps they run: prefill and one-token decode."""
