"""slacken: a GPU metagenomic classifier in JAX (Kraken 2 algorithm).

A from-scratch JAX/XLA implementation with the capabilities of the
Slacken reference (Apache Spark/Scala), re-designed for accelerators:
dense fixed-shape batches, doubling scans instead of sequential loops,
sorted-array indexes probed on device, and jax.sharding meshes instead of
Spark shuffles.
"""

__version__ = "0.1.0"
