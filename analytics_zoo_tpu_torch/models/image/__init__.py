"""Image model zoo (reference zoo/.../models/image): classification.  The
object detection models wait for ROADMAP queue 1 item 15."""
