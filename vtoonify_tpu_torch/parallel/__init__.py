"""Several devices (port of vtoonify_tpu/parallel: `mesh`, `collectives`,
`multihost`): frames split over 'dp', the wide layers' output channels
over 'tp' (`tensor`), one frame's rows over 'sp' (`spatial`), and
data-parallel training, one process per rank. The HLO collective audit and
the XLA compile cache are TPU devices and not ported."""
