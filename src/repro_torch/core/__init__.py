"""Switch data plane: types, hashing, the fused pipeline, the controller."""
