"""The plain reference: the models, the brush stroke and the training
recipe in plain PyTorch, importing nothing of the program."""
