"""Multi-device rendering on ``torch.distributed`` (port of the JAX
package's ``parallel/``): process groups (``distributed``), the rank's
group and device (``mesh``), framebuffer tiles and sample shards
(``sharding``), and the pooled wavefront rebalanced across ranks every
bounce (``rebalance``)."""
