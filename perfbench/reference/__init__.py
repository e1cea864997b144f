"""The plain float32 reference that decides ``correct``: frozen copies of
the port's plain PyTorch path (no kernel, no process group, no import of
the port), with the compositing and the attention in their plain forms.
``steps.py`` holds the eval and train steps the harness compares with."""
