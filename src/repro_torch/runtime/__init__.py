"""The training control plane."""
