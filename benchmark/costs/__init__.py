"""Frozen yardsticks: the card's published peaks, the least work of each
kernel of the port, and the analytic FLOPs of each model configuration.

These are copies, not imports: the port may change its own cost functions,
and a roofline share read here must mean the same work in every change.
"""
