"""Multi-GPU execution of the port: a (data, model) mesh of processes over
`torch.distributed` (`sharding`), the launcher that starts it (`launch`)
and the kernel-launch count that shows K2 and K4 ran on every shard
(`introspect`).  The counterpart of `desktop2stereo_tpu/parallel/`."""
