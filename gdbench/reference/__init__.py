"""The plain reference renderer that decides `correct`: plain PyTorch
and numpy, importing nothing of the program."""
