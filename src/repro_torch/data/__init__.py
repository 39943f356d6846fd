"""Workload generators and the training input pipeline (numpy and a thread)."""
