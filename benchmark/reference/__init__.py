"""The plain reference of the training step, in plain PyTorch.

It follows the configuration's semantics (rsl_rl's PPO as the port and the
JAX package state it) with no kernel, no graph and no cache, and imports
nothing of the port and nothing of JAX. ``precision`` gives each stage's
rounding: the reference computes in the precision each configuration
states, its control one step below.
"""
