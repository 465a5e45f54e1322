"""Scene builders, one module per kind of configuration, named by a
configuration's ``builder``. Each makes the run's inputs from the seed
(``inputs``: the same tensors go to the program and to the reference) and
hands them to the program (``program``)."""
