"""Fixed-shape on-device detection ops (XLA equivalents of the
reference's custom C++/CUDA MXNet operators, reference operator/*.cc|cu)."""
