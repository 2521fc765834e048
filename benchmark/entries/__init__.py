"""How scenes reach the program: one module per way, named by a traffic
file's ``entry``. Each module gives ``MERGED`` (whether the dual wind comes
back merged), ``place`` (a generated scene into the form the program is
handed), ``invert`` (one call of the program, its winds in the caller's
hands), ``take`` (the winds of a sample of pixels) and ``received`` (the
inputs of those pixels as the program received them)."""
