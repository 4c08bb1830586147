"""The plain reference of the benchmark: DESTR's forward (ResNet-50/101 with
the dilated C5), the matcher, the criterion, AdamW and the transforms in
plain PyTorch, frozen copies of the
port's plain versions with the files and lines each names. It imports
nothing of the port, nor JAX."""
