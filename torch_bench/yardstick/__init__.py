"""What decides a cell's numbers and ``correct`` (module docstrings say
what each holds).  Imports nothing of the program."""
