"""Visualization of the port (staticfusion_tpu/viz's layout): map renders
(render), the GUI's image panels (offline), the live HTTP view (live) and
the WebGL map export (webviewer).  None needs a plotting library."""
