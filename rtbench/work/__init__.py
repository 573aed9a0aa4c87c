"""The frozen work model behind the roofline shares."""
