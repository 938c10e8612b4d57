"""The scoring runtime: ``WindowScorer``."""
