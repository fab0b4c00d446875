"""Multi-GPU runtime of the port (``parallel/mesh.py``)."""
