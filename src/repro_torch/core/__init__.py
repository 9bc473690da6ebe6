"""Card specs (hw.py), the Hopper ranking model (gpu_model.py) and the
v0-v10 journey (journey.py)."""
