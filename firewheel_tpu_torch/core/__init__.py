"""Core contracts: nodes, units and the parameter smoother."""
