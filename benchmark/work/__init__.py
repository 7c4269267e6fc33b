"""Operations and bytes of each op, from its shapes alone.

Each op's counter is a file of its own (``work/<op>.py``, ``work(...) ->
(flops, bytes)``): every input byte read once, every output byte written
once, whatever the kernel reads again, and the products the algorithm
needs. ``model.py`` counts a whole step's model FLOPs from a
configuration's shapes.
"""
