"""The port's C shim: ``gooey_shim.cpp`` and its build (``build.py``)."""
