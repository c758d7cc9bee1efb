"""The benchmark's plain reference (float32 PyTorch): see
:mod:`reference.decoder`."""
