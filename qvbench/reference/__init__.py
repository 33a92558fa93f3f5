"""The plain PyTorch reference of what the timed path computes.

It imports nothing of the program: it reads the configuration's
config.json (qvbench/spec.py), takes the benchmark's bf16 weights and the
seeded frames, and works out everything the program derives from them
again (the int8 codes and scales of a configuration served with int8
weights, the RGB pixels, the patches, the positions). model.py is the
model, compare.py the comparison that decides `correct`.
"""
