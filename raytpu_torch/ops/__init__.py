"""Tensor ops of the PyTorch port, one module per ``raytpu/ops`` counterpart."""
