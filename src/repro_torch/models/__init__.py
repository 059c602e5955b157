"""Model zoo of the port: configuration, layers, the dense transformer, the
registry and the conversion of reference parameters."""
