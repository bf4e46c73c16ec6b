"""The framework-free C++ of the host data plane: the cell-list neighbor
builder (``neighbors.cpp``) and the shared-memory sample store
(``ddstore.cpp``), compiled with ``g++`` at first use (``build.py``)."""
