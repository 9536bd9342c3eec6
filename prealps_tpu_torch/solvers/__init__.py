"""The ECG solver (stacked ODIR-fused step) and its panel layout."""
