"""The plain reference of the heatmap job's semantics, in NumPy.

Written from the reference job (github.com/timfpark/heatmap,
``tile.py:8-30`` and ``heatmap.py:25-129``): CPython-double tile math,
the ``background`` filter, user-group routing, the 16-level cascade and
the JSON blobs, plus the window raster and its 2x2 pyramid of the port's
``tiles`` command. It imports
only the standard library and NumPy: nothing of the program, of the JAX
package or of JAX.
"""
