"""Evaluation: pose error metrics and the NOCS mAP protocol."""
