from .box_viz import (draw_box_on_img, draw_boxes_on_views,
                      trans_boxes_to_view, trans_boxes_to_views)
from .img_utils import concat_6_views, img_grid
from .map_viz import MAP_COLORS, visualize_map

__all__ = ["MAP_COLORS", "concat_6_views", "draw_box_on_img",
           "draw_boxes_on_views", "img_grid", "trans_boxes_to_view",
           "trans_boxes_to_views", "visualize_map"]
