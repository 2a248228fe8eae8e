"""The T2M evaluation protocol: generation, evaluator encoders."""
