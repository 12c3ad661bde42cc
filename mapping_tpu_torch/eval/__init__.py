"""Evaluation: COCO AP/AR at IoU 0.5 with the crowdAI fork's summary."""
