"""Camera calibration from field lines and from camera pairs (host code).

Imported lazily by the apps: the detection path of a calibrated camera
imports neither this package nor scipy."""
