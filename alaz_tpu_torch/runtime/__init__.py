"""The scoring runtime: ``WindowScorer``, the streaming ``Service``, its
metrics registry, tenancy partitions and debug HTTP server."""
