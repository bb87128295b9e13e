"""The command-line app: `python -m frad_python_tpu_torch
encode|decode|play|repair|meta|help` (`main.main`)."""
