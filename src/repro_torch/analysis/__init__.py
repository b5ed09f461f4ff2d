"""Cost accounting of one traced call (the dry run's ``analysis/costs``)."""
