"""Several devices (port of vtoonify_tpu/parallel: `mesh`, `collectives`,
`multihost`): frames split over 'dp', one frame's rows split over 'sp'
(`spatial`), and data-parallel training, one process per card. Tensor
parallelism is the next slice (ROADMAP.md); the HLO collective audit and the
XLA compile cache are TPU devices and not ported."""
