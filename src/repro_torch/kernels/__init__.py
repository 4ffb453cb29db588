"""Hand-written Hopper kernels (``csrc/``), their builds and wrappers, the
plain torch oracles (``ref.py``) and the backend dispatch (``dispatch.py``).
"""
