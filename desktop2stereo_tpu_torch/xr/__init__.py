"""XR frame serving: the host half of the reference's OpenXR viewer
(reference xr_viewer/), so a workstation XR client attaches to the pipeline
over the `update_frame(rgb, depth)` interface (reference viewer.py:2359).

Port of the serving side of `desktop2stereo_tpu/xr/`:

- frame_server: the latest-frame mailbox a client polls;
- net: the TCP frame protocol around it, with the meta query and the
  input channel;
- injector: OS input injection (XTest, uinput touch) behind the input
  channel.

Nothing is imported here; the client side (geometry, filters, the client
tool) is not ported yet (ROADMAP A10).
"""
