"""Offline data tooling: the converters that write the on-disk scene format,
with the port's own image codecs (data/format.py's PNG, data/jpeg.py) and
PIL-exact resampling (data/resample.py) in place of PIL.

- carla_postprocess: a CARLA capture -> scene directory (numpy only).
- waymo_convert: Waymo Open Dataset frames -> scene directory; reading
  tfrecords needs waymo-open-dataset and tensorflow (import-gated).
- carla_capture: the synchronous CARLA client recording the 5-camera rig
  (needs the carla package and a simulator; import-gated).
"""
