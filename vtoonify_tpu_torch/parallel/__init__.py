"""Data parallelism on several cards (port of vtoonify_tpu/parallel: `mesh`,
`collectives`, `multihost`). GSPMD tensor and spatial partitioning, the HLO
collective audit and the XLA compile cache are TPU devices and not ported."""
