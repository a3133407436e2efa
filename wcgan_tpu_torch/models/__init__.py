"""PyTorch modules of the port: WC layers, SN wrappers, G and D."""
