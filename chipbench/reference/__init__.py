"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
with PIL (libjpeg) for decoding. It imports nothing of the program."""
