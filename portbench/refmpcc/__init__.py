"""The benchmark's plain reference: one MPCC tick and the plant in plain
PyTorch, in the dtype it is given (float64 for the check).

A frozen copy of the port's plain routes (every kernel in its plain
version: K4's kinematics, K2's stage assembly, K1's structured interior
point, K3's evaluation, K5's ADMM loop), trimmed to what a tick runs.  It
imports nothing of the port, builds its own track spline and parameters
from a configuration file, and reads the collision networks' raw files.
"""
