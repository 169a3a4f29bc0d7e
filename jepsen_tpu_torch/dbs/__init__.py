"""Reusable DB wrappers (the reference keeps these in db.clj itself;
the port's copy of jepsen_tpu/dbs/)."""
